"""The port's router core (`llm_training_tpu_torch/serve/router.py`)
against JAX's, on the stub sequences of `tests/test_router.py`.

Every case of that file runs twice: once as it is, over JAX's `Router`,
and once with the module's imports pointed at the port's (the same
source, read and executed into a second namespace). In both runs the
`Router` is wrapped so that each public call is recorded with its
arguments and its result (requests and stub handles flattened to plain
data); the two recordings, and every file the case wrote under its
`tmp_path` (the router journals), must be equal. Each case also passes its
own assertions on both sides. The CLI's `route` end to end over real
`serve` children is `tests/test_torch_route.py`.
"""

from __future__ import annotations

import ast
import types
from pathlib import Path

import pytest

from llm_training_tpu.serve import router as jax_router
from llm_training_tpu_torch.serve import router as port_router

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "tests" / "test_router.py").read_text()
_TREE = ast.parse(SOURCE)
CASES = [node.name for node in _TREE.body
         if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")]
# the cases that build a Router (the rest test the id and journal helpers)
_DRIVES_ROUTER = {node.name for node in _TREE.body if isinstance(node, ast.FunctionDef)
                  and "_router(" in ast.get_source_segment(SOURCE, node)}

# the Router methods a caller (the route loop, a test) drives
_RECORDED = ("intake", "resume", "assign", "park", "take_pending", "record_token",
             "record_done", "synthesize_done", "fail_replica", "update_fleet",
             "maybe_hedge", "scale_decision", "register_replica", "retire_replica",
             "mark_retiring", "set_target", "target", "inflight",
             "request_ids_inflight", "live_stats", "stats", "next_ordinal")


def _plain(value):
    """JSON-able data of a router result: requests by their fields, stub
    handles by (rid, port), containers element by element."""
    if isinstance(value, dict):
        return {str(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(_plain(v) for v in value)
    if isinstance(value, Path):
        return value.name
    if type(value).__name__ == "RoutedRequest":
        return {"RoutedRequest": {slot: _plain(getattr(value, slot, None))
                                  for slot in type(value).__slots__}}
    if hasattr(value, "rid") and hasattr(value, "port"):
        return {"handle": [value.rid, value.port]}
    if hasattr(value, "path") and type(value).__name__ == "RequestJournal":
        return {"journal": Path(value.path).name}
    return value


def _recording(router_cls, log: list):
    methods = {}
    for name in _RECORDED:
        def call(self, *args, _name=name, **kwargs):
            out = getattr(router_cls, _name)(self, *args, **kwargs)
            log.append([_name, _plain(args), _plain(kwargs), _plain(out)])
            return out
        methods[name] = call
    return type("RecordingRouter", (router_cls,), methods)


def _namespace(package: str, log: list) -> dict:
    """`tests/test_router.py` executed with its imports taken from `package`,
    its `Router` recording into `log`."""
    source = SOURCE.replace("from llm_training_tpu.", f"from {package}.")
    module = types.ModuleType(f"router_cases_{package}")
    module.__file__ = str(ROOT / "tests" / "test_router.py")
    exec(compile(source, module.__file__, "exec"), module.__dict__)
    module.Router = _recording(module.Router, log)
    return module.__dict__


def _files(root: Path) -> dict[str, str]:
    return {str(path.relative_to(root)): path.read_text()
            for path in sorted(root.rglob("*")) if path.is_file()}


def _run(namespace: dict, name: str, tmp: Path, monkeypatch) -> None:
    fn = namespace[name]
    kwargs = {}
    for arg in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        kwargs[arg] = {"tmp_path": tmp, "monkeypatch": monkeypatch}[arg]
    tmp.mkdir(parents=True, exist_ok=True)
    fn(**kwargs)


@pytest.mark.parametrize("case", CASES)
def test_router_cases_match_jax(case, tmp_path, monkeypatch):
    logs = {"jax": [], "port": []}
    spaces = {"jax": _namespace("llm_training_tpu", logs["jax"]),
              "port": _namespace("llm_training_tpu_torch", logs["port"])}
    assert spaces["port"]["Router"].__mro__[1] is port_router.Router
    assert spaces["jax"]["Router"].__mro__[1] is jax_router.Router
    for side in ("jax", "port"):
        with monkeypatch.context() as patch:
            _run(spaces[side], case, tmp_path / side, patch)
    assert logs["port"] == logs["jax"]
    assert bool(logs["jax"]) == (case in _DRIVES_ROUTER)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("deadline_ms", [None, 250.0])
def test_leg_records_match_jax(deadline_ms):
    """The record a replica receives for one leg: delivered tokens folded
    into the prompt, the budget and deadline cut by what was spent."""
    records = []
    for module in (jax_router, port_router):
        req = module.RoutedRequest(id="c-1", prompt=[1, 2, 3], max_new_tokens=8, priority=2,
                                   deadline_ms=deadline_ms, arrival_s=10.0)
        req.generated = [7, 9]
        req.emitted = 2
        records.append(module._leg_record(req, "r1", clock=lambda: 10.1))
    assert records[0] == records[1]
    assert records[1]["id"] == "r1::c-1" and records[1]["prompt"] == [1, 2, 3, 7, 9]
