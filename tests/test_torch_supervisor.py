"""Port parity of crash-restart supervision and elastic planning on the
CPU: the `Supervisor`'s decisions and `supervisor.jsonl` events against
JAX's for the same scripted child exits, the topology planner and the data
continuity check against JAX's over a grid of inputs, the goodput ledger's
cost basis, the trainer's elastic front door, and one real `supervise` run
of the tiny CPU config healed after a chaos SIGKILL.
"""

import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from llm_training_tpu.resilience import elastic as jax_elastic
from llm_training_tpu.resilience import supervisor as jax_supervisor
from llm_training_tpu.telemetry.goodput import GoodputLedger as JaxLedger
from llm_training_tpu_torch.cli.config import load_config
from llm_training_tpu_torch.cli.main import build_fit
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.resilience import elastic, supervisor
from llm_training_tpu_torch.telemetry.goodput import GoodputLedger

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- supervisor


def _drive(module, tmp_path, rcs, runtimes=(), probes=None, **config):
    """One Supervisor of `module` over scripted exit codes, each child
    lasting the next scripted runtime on a fake clock: (return code, events
    without timestamps, the jsonl's records without timestamps, sleeps, the
    attempts the children saw)."""
    log = tmp_path / module.__name__.split(".")[0] / "supervisor.jsonl"
    codes, times, slept, seen = list(rcs), list(runtimes), [], []
    now = [0.0]
    sup = module.Supervisor(
        ["python", "-m", "child"], module.SupervisorConfig(log_path=str(log), **config),
        sleep=slept.append, clock=lambda: now[0],
        probe=(lambda: probes.pop(0)) if probes is not None else None,
    )

    def run_child(argv):
        seen.append(sup.env[jax_elastic.ATTEMPT_ENV])
        now[0] += times.pop(0) if times else 1.0
        return codes.pop(0)

    sup._run_child = run_child
    rc = sup.run()
    strip = lambda records: [{k: v for k, v in r.items() if k != "ts"} for r in records]  # noqa: E731
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert sup.env[jax_elastic.SUPERVISOR_LOG_ENV] == str(log.absolute())
    return rc, strip(sup.events), strip(lines), slept, seen


SCRIPTS = {
    "resumable_then_complete": dict(rcs=[75, 0]),
    "sigkill_then_complete": dict(rcs=[-9, 0]),
    "giveup_77": dict(rcs=[77]),
    "mixed": dict(rcs=[75, -9, -6, 0], runtimes=[5.0, 700.0, 1.0, 1.0]),
    "giveup_76_after_restart": dict(rcs=[-11, 76]),
    "budget_exhausted": dict(rcs=[-9] * 4, max_restarts=3, backoff_max_s=3.0),
    "signals_off": dict(rcs=[-9], restart_on_signals=False),
    "capacity_wait": dict(rcs=[75, 0], probes=[0, 1, 4], min_devices=2, probe_backoff_s=0.5),
    "capacity_giveup": dict(rcs=[75], probes=[0, 0, 0], min_devices=2, probe_backoff_s=0.0,
                            probe_max_wait_s=0.0),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervisor_decisions_match_jax(tmp_path, name):
    """Scripted exits 75, -9 (and -6, -11), 0, 76, 77 through both
    Supervisors: the same return code, the same events and jsonl records
    (launch/exit/restart/giveup/complete/probe/capacity_wait, signal names,
    backoffs with the healthy-runtime reset), the same sleeps and the same
    LLMT_SUPERVISOR_ATTEMPT seen by each child."""
    script = dict(SCRIPTS[name])
    runs = []
    for module in (supervisor, jax_supervisor):
        kwargs = {k: (list(v) if isinstance(v, list) else v) for k, v in script.items()}
        runs.append(_drive(module, tmp_path, **kwargs))
    assert runs[0] == runs[1]
    rc, events, lines, _, _ = runs[0]
    assert events == lines
    assert rc == {"giveup_77": 77, "giveup_76_after_restart": 76, "budget_exhausted": 137,
                  "signals_off": 137, "capacity_giveup": 75}.get(name, 0)


def test_supervisor_real_children_match_jax(tmp_path):
    """Children that are real `python -c` processes: attempt 1 exits 75,
    attempt 2 SIGKILLs itself, attempt 3 exits 0. Both Supervisors log the
    same lifecycle."""
    code = ("import os, signal, sys; a = int(os.environ['LLMT_SUPERVISOR_ATTEMPT']); "
            "sys.exit(75) if a == 1 else (os.kill(os.getpid(), signal.SIGKILL) if a == 2 "
            "else sys.exit(0))")
    runs = []
    for module in (supervisor, jax_supervisor):
        log = tmp_path / module.__name__.split(".")[0] / "supervisor.jsonl"
        sup = module.Supervisor([sys.executable, "-c", code],
                                module.SupervisorConfig(log_path=str(log), backoff_base_s=0.0))
        assert sup.run() == 0
        runs.append([(e["event"], e.get("rc"), e.get("signal"), e.get("reason"))
                     for e in sup.events])
    assert runs[0] == runs[1] == [
        ("launch", None, None, None), ("exit", 75, None, None),
        ("restart", None, None, "resumable exit 75"), ("launch", None, None, None),
        ("exit", -9, "SIGKILL", None), ("restart", None, None, "hard death (SIGKILL)"),
        ("launch", None, None, None), ("exit", 0, None, None), ("complete", None, None, None)]


def test_supervisor_config_and_argv_match_jax():
    ours = supervisor.SupervisorConfig()
    want = jax_supervisor.SupervisorConfig().model_dump()
    assert {k: getattr(ours, k) for k in want} == want
    for bad in (dict(max_restarts=-1), dict(backoff_factor=0.5), dict(min_devices=0)):
        with pytest.raises(ValueError):
            supervisor.SupervisorConfig(**bad)
    argv = supervisor.build_fit_argv("c.json", ["a=1", "--device", "cpu"], ckpt_path="4")
    assert argv == [sys.executable, "-m", "llm_training_tpu_torch", "fit", "--config", "c.json",
                    "--ckpt-path", "4", "a=1", "--device", "cpu"]
    assert argv[4:] == jax_supervisor.build_fit_argv("c.json", ["a=1", "--device", "cpu"],
                                                     ckpt_path="4")[4:]
    serve = supervisor.build_serve_argv("c.json", ["--device", "cpu", "--max-queue", "4"],
                                        ckpt_path="4")
    assert serve[:4] == [sys.executable, "-m", "llm_training_tpu_torch", "serve"]
    for args in ((["--device", "cpu", "--max-queue", "4"], "4"), ([], None)):
        assert (supervisor.build_serve_argv("c.json", *args)[4:]
                == jax_supervisor.build_serve_argv("c.json", *args)[4:])


def test_stale_log_env_is_not_inherited(tmp_path, monkeypatch):
    monkeypatch.setenv(elastic.SUPERVISOR_LOG_ENV, "/elsewhere/supervisor.jsonl")
    assert elastic.SUPERVISOR_LOG_ENV not in supervisor.Supervisor(["x"]).env
    sup = supervisor.Supervisor(["x"], supervisor.SupervisorConfig(log_path="s.jsonl"))
    assert sup.env[elastic.SUPERVISOR_LOG_ENV] == str(Path("s.jsonl").absolute())


# ---------------------------------------------------------------- elastic


def _outcome(fn, *args, **kwargs):
    try:
        plan = fn(*args, **kwargs)
    except Exception as e:  # the error's type and message are compared
        return ("error", type(e).__name__, str(e))
    return (plan.device_count, plan.spare_devices, plan.axis_sizes, plan.decision, plan.source,
            plan.data_parallel_size)


def test_plan_topology_matches_jax_over_a_grid():
    """Fresh starts and resumes over device pools 0-9, auto and explicit
    axes, conflicting checkpoints and global batches: the same plan or the
    same error as JAX's planner."""
    configs = [
        {"data": 1, "fsdp": -1},
        {"data": -1},
        {"data": 2, "fsdp": 2},
        {"data": 1, "tensor": 2, "fsdp": -1},
        {"data": -1, "fsdp": -1},
        {"data": 4, "pipe": 2},
        {"data": 1, "expert": 2, "sequence": 1},
    ]
    checkpoints = [None, {"data": 4, "fsdp": 2, "pipe": 1, "expert": 1, "tensor": 1,
                          "sequence": 1},
                   {"data": 2, "tensor": 2}, {"fsdp": 3}]
    batches = [None, 8, 6, 7]
    cases = errors = 0
    for available in range(0, 10):
        for config in configs:
            for ckpt in checkpoints:
                for batch in batches:
                    got = _outcome(elastic.plan_topology, available, config, ckpt, batch)
                    want = _outcome(jax_elastic.plan_topology, available, config, ckpt, batch)
                    assert got == want, (available, config, ckpt, batch)
                    cases += 1
                    errors += got[0] == "error"
    assert cases == 10 * 7 * 4 * 4 and 0 < errors < cases


def test_plan_single_device_needs_a_mesh_for_more():
    """The planner over the live world (`plan_live_world`): one rank plans
    every axis 1; four ranks fill the config's auto axis or scale data
    against the checkpoint's model axes, a resume onto other degrees
    included; a plan that leaves ranks idle, or shards the pipe axis,
    raises (A.9b)."""
    one = elastic.plan_live_world(1, {"fsdp": -1})
    assert one.axis_sizes == elastic.single_device_mesh() and one.device_count == 1
    assert one.decision == "fresh start: filled fsdp=1, data=1"
    mesh = elastic.plan_live_world(4, {"fsdp": 2, "tensor": 2})
    assert mesh.axis_sizes == {**elastic.single_device_mesh(), "fsdp": 2, "tensor": 2}
    resumed = elastic.plan_live_world(4, {"fsdp": 2, "tensor": 2},
                                      {**elastic.single_device_mesh(), "fsdp": 2, "tensor": 2}, 8)
    assert resumed.decision == "unchanged (data=1)" and resumed.source == "checkpoint"
    scaled = elastic.plan_live_world(4, {"data": -1, "fsdp": 1},
                                     {**elastic.single_device_mesh(), "data": 2}, 8)
    assert scaled.axis_sizes["data"] == 4 and scaled.decision == "scaled data 2->4"
    with pytest.raises(elastic.ElasticTopologyError, match="relaunch with 2"):
        elastic.plan_live_world(3, {"data": -1, "fsdp": 2}, None, 8)
    with pytest.raises(NotImplementedError, match="A.9b"):
        elastic.plan_live_world(2, {"pipe": 2, "fsdp": 1})
    assert elastic.single_device_mesh() == {a: 1 for a in
                                            ("data", "pipe", "fsdp", "expert", "tensor",
                                             "sequence")}


@pytest.mark.parametrize("elastic_on", [True, False], ids=["elastic", "legacy"])
def test_check_data_continuity_matches_jax(elastic_on, caplog):
    """Under elastic a changed global batch raises JAX's ValueError; without
    it, JAX's warning. An unchanged batch, a missing rider and a DP resize
    pass silently in both."""
    state = {"global_batch_size": 8, "sample_cursor": 96, "replica_stride": 4}
    outcomes = []
    for module in (elastic, jax_elastic):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            try:
                module.check_data_continuity(state, 16, elastic=elastic_on)
                outcome = ("warned", [r.getMessage() for r in caplog.records])
            except ValueError as e:
                outcome = ("raised", str(e))
            for quiet in ((state, 8), (None, 16), ({}, 16), ({"global_batch_size": 0}, 3)):
                module.check_data_continuity(*quiet, elastic=elastic_on)
        outcomes.append(outcome)
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("raised" if elastic_on else "warned")
    assert "8 -> 16" in str(outcomes[0][1]) and "96 samples" in str(outcomes[0][1])


def test_environment_helpers_match_jax(monkeypatch, tmp_path):
    for raw, attempt in (("8,4", 1), ("8,4", 2), ("8,4", 5), ("3", 2), ("x", 1), ("0", 1),
                         ("", 1), (" 5 , ", 1)):
        monkeypatch.setenv(elastic.CHAOS_DEVICES_ENV, raw)
        monkeypatch.setenv(elastic.ATTEMPT_ENV, str(attempt))
        assert elastic.chaos_device_limit() == jax_elastic.chaos_device_limit(), raw
        assert elastic.segment_attempt() == jax_elastic.segment_attempt() == attempt
    for raw in ("2.5", "-1", "abc", ""):
        monkeypatch.setenv(elastic.CHIP_PRICE_ENV, raw)
        for price in (None, 3.0):
            assert (elastic.resolve_chip_price(elastic.ElasticConfig(price))
                    == jax_elastic.resolve_chip_price(jax_elastic.ElasticConfig(
                        price_per_chip_hour=price))), (raw, price)
    with pytest.raises(ValueError):
        elastic.ElasticConfig(price_per_chip_hour=0.0)
    monkeypatch.setenv(elastic.ATTEMPT_ENV, "2")
    records = []
    for module, name in ((elastic, "port"), (jax_elastic, "jax")):
        path = tmp_path / f"{name}.jsonl"
        assert module.log_segment_topology({"data": 1}, 1, path=str(path)) is not None
        records.append(module.log_segment_topology(
            elastic.single_device_mesh(), 1, decision="static mesh",
            price_per_chip_hour=2.0, path=str(path)))
        records[-1].pop("ts")
    assert records[0] == records[1]
    monkeypatch.delenv(elastic.SUPERVISOR_LOG_ENV, raising=False)
    assert elastic.log_segment_topology({"data": 1}, 1) is None


def test_goodput_cost_basis_matches_jax():
    """`set_cost_basis` adds JAX's chip-hour and per-dollar keys to the
    summary, on the same clock."""
    for basis in ((None, None), (1, None), (4, 2.5), (1, 0.0)):
        summaries = []
        for cls in (GoodputLedger, JaxLedger):
            ticks = iter([0.0, 1.0, 4.0, 3600.0 + 7.0])
            ledger = cls(clock=lambda: next(ticks))
            ledger.set_cost_basis(*basis)
            ledger.start()
            with ledger.measure("step_compute"):
                pass
            summaries.append(ledger.summary())
        assert summaries[0] == summaries[1], basis
    assert summaries[0]["goodput/chip_count"] == 1.0 and "goodput/cost_dollars" not in summaries[0]


# ---------------------------------------------------------------- the trainer


def _cli_config(tmp_path, **trainer) -> Path:
    config = json.loads((ROOT / "llm_training_tpu_torch/config/cpu-smoke.json").read_text())
    config["run_root"] = str(tmp_path)
    config["trainer"].update({
        "max_steps": 6, "log_every_n_steps": 1, "val_check_interval": None,
        "checkpoint_every_n_steps": 2,
        "checkpoint": {"dirpath": str(tmp_path / "ckpt"), "async_save": False}, **trainer})
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    return path


def _losses(run_root) -> dict[int, float]:
    rows = (Path(run_root) / "smoke" / "cpu-smoke" / "metrics.jsonl").read_text().splitlines()
    return {r["step"]: r["loss"] for r in map(json.loads, rows) if "loss" in r}


def _final_params(path) -> dict[str, torch.Tensor]:
    trainer, objective, _ = build_fit(load_config(path), "cpu")
    state = trainer.restore_for_inference(objective)
    trainer.checkpointer.close()
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_elastic_fit_publishes_its_topology(tmp_path, monkeypatch):
    """`resilience.elastic` on the CPU: the planner's one-device plan (over
    the config's mesh, JAX's default `fsdp_size: -1` filled to 1), the
    `elastic/*` gauges and the ledger's cost basis in the telemetry, the
    `topology` rider in the checkpoint, a `segment_topology` event in the
    supervisor's log; a resume that changes the global batch is refused."""
    log = tmp_path / "supervisor.jsonl"
    monkeypatch.setenv(elastic.SUPERVISOR_LOG_ENV, str(log))
    monkeypatch.setenv(elastic.ATTEMPT_ENV, "3")
    monkeypatch.setenv(elastic.CHIP_PRICE_ENV, "2.0")
    path = _cli_config(tmp_path, max_steps=2, resilience={"elastic": {}})
    assert cli_main(["fit", "--config", str(path), "--device", "cpu"]) == 0
    record = json.loads((tmp_path / "smoke" / "cpu-smoke" / "telemetry.jsonl")
                        .read_text().splitlines()[-1])
    assert (record["elastic/segment"], record["elastic/device_count"],
            record["elastic/data_parallel_size"]) == (3, 1, 1)
    assert record["goodput/chip_count"] == 1.0 and record["goodput/price_per_chip_hour"] == 2.0
    meta = json.loads((tmp_path / "ckpt" / "step_2" / "meta.json").read_text())
    assert meta["topology"] == {"device_count": 1, "mesh": elastic.single_device_mesh()}
    (event,) = [json.loads(line) for line in log.read_text().splitlines()]
    assert (event["event"], event["attempt"], event["decision"], event["mesh"],
            event["price_per_chip_hour"]) == (
                "segment_topology", 3, "fresh start: filled fsdp=1, data=1",
                elastic.single_device_mesh(), 2.0)
    with pytest.raises(ValueError, match="GLOBAL batch size 8 -> 4"):
        cli_main(["fit", "--config", str(path), "--device", "cpu", "trainer.max_steps=4",
                  "data.init_args.batch_size=4"])


def test_supervised_fit_heals_a_sigkill(tmp_path, monkeypatch):
    """`supervise` over the tiny CPU config with LLMT_CHAOS_SIGKILL_STEP=3:
    the child dies on SIGKILL after step 3, the supervisor relaunches it,
    the relaunch restores step 2 and completes; supervisor.jsonl holds
    launch, exit (SIGKILL), restart, launch, complete, and the children's
    segment_topology events; the losses and final parameters equal an
    uninterrupted run's (one intra-op thread in both, so the CPU sums in
    one order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        clean = _cli_config(tmp_path / "clean")
        assert cli_main(["fit", "--config", str(clean), "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(threads)
    supervised = _cli_config(tmp_path / "supervised")
    monkeypatch.setenv("LLMT_CHAOS_SIGKILL_STEP", "3")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.chdir(ROOT)
    rc = cli_main(["supervise", "--config", str(supervised), "--child-args", "--device cpu",
                   "--backoff-base-s", "0"])
    assert rc == 0
    log = tmp_path / "supervised" / "smoke" / "cpu-smoke" / "supervisor.jsonl"
    events = [json.loads(line) for line in log.read_text().splitlines()]
    lifecycle = [(e["event"], e.get("signal")) for e in events if e["event"] != "segment_topology"]
    assert lifecycle == [("launch", None), ("exit", "SIGKILL"), ("restart", None),
                         ("launch", None), ("exit", None), ("complete", None)]
    segments = [e["attempt"] for e in events if e["event"] == "segment_topology"]
    assert segments == [1, 2]
    assert _losses(tmp_path / "supervised") == _losses(tmp_path / "clean")
    assert sorted(_losses(tmp_path / "clean")) == [1, 2, 3, 4, 5, 6]
    ours, want = _final_params(supervised), _final_params(clean)
    for name, tensor in want.items():
        assert torch.equal(ours[name], tensor), name
    assert not np.isnan(_losses(tmp_path / "supervised")[6])


def test_probe_reads_the_device_count_in_a_subprocess(monkeypatch):
    """The default probe runs `visible_device_count` in a fresh interpreter
    under the children's environment (the chaos clamp applies there)."""
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    sup = supervisor.Supervisor(["x"], supervisor.SupervisorConfig(probe_max_wait_s=60.0))
    count = sup._probe_devices()
    assert count == torch.cuda.device_count()
    proc = subprocess.run(
        [sys.executable, "-c", "import os, sys; sys.exit(0)"], env=sup.env, timeout=60)
    assert proc.returncode == 0 and os.environ.get("PYTHONPATH") == str(ROOT)
