"""Port parity of the serving slice as a whole: the port's `ServingEngine`
must produce greedy tokens identical to the JAX `ServingEngine` on the same
carried weights -- ragged prompts across page boundaries, mid-stream
admission, eviction then resume -- and leave its pool leak-free. Also the
JSONL protocol of `python -m llm_training_tpu_torch serve`, in process on
the CPU, and the sampling filters against the JAX ones."""

import io
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu.infer import sampling as jax_sampling
from llm_training_tpu.serve import ServeConfig as JaxServeConfig
from llm_training_tpu.serve import ServingEngine as JaxServingEngine
from llm_training_tpu_torch import prng
from llm_training_tpu_torch.cli.main import build_model, build_parser, run_serve
from llm_training_tpu_torch.infer import sampling
from llm_training_tpu_torch.serve.engine import ServeConfig, ServingEngine
from test_torch_llama import TINY, jax_model_and_params, port_model

PROMPTS = [[3, 17, 42, 7, 11], [5, 9], [1, 2, 3]]
SERVE = dict(max_batch=2, max_model_len=48, block_size=8, prefill_chunk=4, eos_token_id=None)


def _engines(scan_layers=True, **overrides):
    jax_model, variables, params = jax_model_and_params(scan_layers)
    config = {**SERVE, **overrides}
    return (
        JaxServingEngine(jax_model, variables, JaxServeConfig(**config)),
        ServingEngine(port_model(params), ServeConfig(**config), device="cpu"),
    )


def _done(events):
    return {e["id"]: e for e in events if e["type"] == "done"}


@pytest.mark.parametrize("scan_layers", [True, False], ids=["scan", "looped"])
def test_greedy_tokens_identical_to_jax_engine(scan_layers):
    jax_engine, engine = _engines(scan_layers)
    requests = [
        {"id": str(row), "prompt": p, "max_new_tokens": 8} for row, p in enumerate(PROMPTS)
    ]
    expected = _done(jax_engine.run(requests))
    got = _done(engine.run(requests))
    for row in map(str, range(len(PROMPTS))):
        assert got[row]["tokens"] == expected[row]["tokens"], f"row {row}"
        np.testing.assert_allclose(
            got[row]["logprobs"], expected[row]["logprobs"], rtol=1e-4, atol=1e-4
        )
    assert engine.allocator.blocks_in_use == 0, "pool leak after drain"
    assert engine.stats()["serve/requests_completed"] == len(PROMPTS)


@pytest.mark.parametrize("temperature,top_k,top_p,seed", [
    (1.0, None, None, 0), (0.8, 20, 0.9, 5),
], ids=["t1", "t0.8_k20_p0.9"])
def test_temperature_tokens_identical_to_jax_engine(temperature, top_k, top_p, seed):
    """Temperature sampling draws under fold_in(key(seed), call) with the
    call counter advancing on every prefill chunk (prompt 0 takes two) and
    every decode step, as the JAX engine does: the same seed gives the same
    tokens and logprobs, with two rows decoding together."""
    sampling_kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    jax_model, variables, params = jax_model_and_params(True)
    jax_engine = JaxServingEngine(jax_model, variables, JaxServeConfig(
        **SERVE, seed=seed, sampling=jax_sampling.SamplingConfig(**sampling_kw)))
    engine = ServingEngine(port_model(params), ServeConfig(
        **SERVE, seed=seed, sampling=sampling.SamplingConfig(**sampling_kw)), device="cpu")
    requests = [
        {"id": str(row), "prompt": p, "max_new_tokens": 12} for row, p in enumerate(PROMPTS)
    ]
    expected = _done(jax_engine.run(requests))
    got = _done(engine.run(requests))
    greedy = _done(_engines()[1].run(requests))
    for row in map(str, range(len(PROMPTS))):
        assert got[row]["tokens"] == expected[row]["tokens"], f"row {row}"
        np.testing.assert_allclose(
            got[row]["logprobs"], expected[row]["logprobs"], rtol=1e-4, atol=1e-4
        )
    assert any(got[r]["tokens"] != greedy[r]["tokens"] for r in got), "nothing was sampled"
    assert engine._call == jax_engine._call


def test_mid_stream_admission_matches_jax_engine():
    """A request submitted while another is mid-decode joins the same
    decode batch, and both finish token-identical to the JAX engine."""
    first, second = [3, 17, 42, 7], [5, 9, 11]
    results = []
    for engine in _engines():
        events = list(engine.submit("first", first, max_new_tokens=8))
        while sum(e["type"] == "token" for e in events) < 2:
            events.extend(engine.step())
        events.extend(engine.submit("second", second, max_new_tokens=8))
        events.extend(engine.step())
        assert len(engine.scheduler.running) == 2, "second not admitted mid-flight"
        while not engine.scheduler.idle:
            events.extend(engine.step())
        assert engine.peak_running == 2 and engine.allocator.blocks_in_use == 0
        results.append({k: v["tokens"] for k, v in _done(events).items()})
    assert results[1] == results[0]


def test_eviction_then_resume_matches_jax_engine():
    """3 usable blocks of 8 for two requests growing to 15-16 tokens: a
    page-boundary growth evicts, the victim re-prefills prompt + generated
    and continues token-identically."""
    jax_engine, engine = _engines(max_model_len=32, num_blocks=3)
    requests = [
        {"id": "0", "prompt": [3, 17, 42, 7], "max_new_tokens": 12},
        {"id": "1", "prompt": [5, 9, 11], "max_new_tokens": 12},
    ]
    expected = _done(jax_engine.run(requests))
    events = engine.run(requests)
    got = _done(events)
    assert engine.scheduler.evictions >= 1, "pool pressure never evicted"
    assert {k: v["tokens"] for k, v in got.items()} == {
        k: v["tokens"] for k, v in expected.items()
    }
    # every token streams exactly once despite the evict/resume round trip
    assert sum(e["type"] == "token" for e in events) == 24
    assert engine.allocator.blocks_in_use == 0


def test_cli_serve_protocol(tmp_path):
    """Request lines, a malformed line, then EOF: token/done chunks per
    request, an error chunk for the bad line, and a final stats record."""
    _, _, params = jax_model_and_params(True)
    flat = {}

    def flatten(node, prefix):
        for key, value in node.items():
            if isinstance(value, dict):
                flatten(value, f"{prefix}{key}/")
            else:
                flat[f"{prefix}{key}"] = value

    flatten(params, "")
    np.savez(tmp_path / "w.npz", **flat)
    (tmp_path / "model.json").write_text(json.dumps(TINY))
    args = build_parser().parse_args([
        "serve", "--model-config", str(tmp_path / "model.json"),
        "--weights", str(tmp_path / "w.npz"), "--max-batch", "2",
        "--max-model-len", "48", "--block-size", "8", "--prefill-chunk", "4",
        "--max-new-tokens", "5", "--device", "cpu",
    ])
    stdin = io.StringIO(
        json.dumps({"id": "a", "prompt": PROMPTS[0], "max_new_tokens": 6}) + "\n"
        + "{not json\n"
        + json.dumps({"id": "b", "prompt": PROMPTS[1]}) + "\n"
        + json.dumps({"id": "c"}) + "\n"
    )
    stdout = io.StringIO()
    assert run_serve(args, stdin=stdin, stdout=stdout) == 0
    records = [json.loads(line) for line in stdout.getvalue().splitlines()]
    assert records[-1]["type"] == "stats"
    assert records[-1]["stats"]["serve/requests_completed"] == 2
    assert sum(r["type"] == "error" for r in records) == 2  # bad JSON, missing prompt
    done = _done(records)
    assert done["a"]["n_tokens"] == 6 and done["b"]["n_tokens"] == 5
    for rid in ("a", "b"):
        streamed = [r["token"] for r in records if r["type"] == "token" and r["id"] == rid]
        assert streamed == done[rid]["tokens"]
    # the CLI serves what the engine API serves on the same weights
    _, engine = _engines()
    direct = _done(engine.run([{"id": "a", "prompt": PROMPTS[0], "max_new_tokens": 6}]))
    assert direct["a"]["tokens"] == done["a"]["tokens"]


def test_engine_needs_cuda_unless_cpu_is_asked_for():
    _, _, params = jax_model_and_params(True)
    model = port_model(params)
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(model, ServeConfig(**SERVE))
    args = SimpleNamespace(device="cuda", preset="llama-3.1-8b", model_config=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(args)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.8), (0.5, 10, 0.9),
])
def test_filtered_logits_match_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(7).standard_normal((3, 64)).astype(np.float32) * 3
    ours = sampling.filtered_logits(
        torch.from_numpy(logits), sampling.SamplingConfig(temperature, top_k, top_p)
    )
    theirs = jax_sampling.filtered_logits(
        jnp.asarray(logits), jax_sampling.SamplingConfig(
            temperature=temperature, top_k=top_k, top_p=top_p
        ),
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)


def test_sampling_greedy_draws_nothing_and_seeded_draws_repeat():
    logits = torch.from_numpy(
        np.random.default_rng(8).standard_normal((4, 32)).astype(np.float32)
    )
    tokens, logprobs = sampling.sample_tokens_with_logprob(
        logits, None, sampling.SamplingConfig()
    )
    assert torch.equal(tokens, logits.argmax(-1))
    torch.testing.assert_close(logprobs, torch.log_softmax(logits, -1).max(-1).values)
    config = sampling.SamplingConfig(temperature=1.0, top_k=8)
    draws = [
        sampling.sample_tokens_with_logprob(logits, prng.key(3), config)[0]
        for _ in range(2)
    ]
    assert torch.equal(draws[0], draws[1])
    kept = torch.topk(logits, 8, dim=-1).indices
    assert all(int(t) in kept[row].tolist() for row, t in enumerate(draws[0]))
    with pytest.raises(ValueError):
        sampling.SamplingConfig(top_p=1.5)


def test_deadlines_match_jax_engine():
    """`deadline_ms`: a request whose deadline has passed while it is queued
    ends with stop_reason 'deadline' and no token; one whose deadline
    passes mid-decode (its deadline moved into the past after 3 tokens, on
    both engines at the same step) ends with 'deadline' and the tokens
    streamed so far, its blocks back in the pool. The JAX engine and the
    port's give the same stop reasons, token counts and tokens."""
    results = []
    for engine in _engines():
        events = list(engine.submit("long", PROMPTS[0], max_new_tokens=8))
        events += engine.submit("late", PROMPTS[1], max_new_tokens=8, deadline_ms=0)
        events += engine.submit("cut", PROMPTS[2], max_new_tokens=8, deadline_ms=3_600_000)
        while True:
            events.extend(engine.step())
            cut = next((r for r in engine.scheduler.running.values() if r.id == "cut"), None)
            if cut is not None and len(cut.generated) == 3:
                break
        cut.deadline_s = 0.0  # the hour has passed
        while not engine.scheduler.idle:
            events.extend(engine.step())
        assert engine.allocator.blocks_in_use == 0
        assert engine.stats()["serve/deadline_total"] == 2
        results.append({k: (v["stop_reason"], v["n_tokens"], v["tokens"])
                        for k, v in _done(events).items()})
    assert results[1] == results[0]
    assert results[1]["late"] == ("deadline", 0, [])
    assert results[1]["cut"][:2] == ("deadline", 3)
    assert results[1]["long"][:2] == ("max_tokens", 8)


def _serve_cli(tmp_path, lines, *flags):
    (tmp_path / "model.json").write_text(json.dumps(TINY))
    args = build_parser().parse_args([
        "serve", "--model-config", str(tmp_path / "model.json"), "--max-batch", "2",
        "--max-model-len", "48", "--block-size", "8", "--prefill-chunk", "4",
        "--max-new-tokens", "5", "--eos-token-id", "-1", "--device", "cpu", *flags,
    ])
    stdout = io.StringIO()
    assert run_serve(args, stdin=io.StringIO("".join(json.dumps(x) + "\n" for x in lines)),
                     stdout=stdout) == 0
    return [json.loads(line) for line in stdout.getvalue().splitlines()]


def test_cli_serve_passes_deadline_ms(tmp_path):
    """The protocol's `deadline_ms` reaches the engine: a request already
    past its deadline ends with stop_reason 'deadline' and no token."""
    records = _serve_cli(tmp_path, [{"id": "a", "prompt": [1, 2], "deadline_ms": 0},
                                    {"id": "b", "prompt": [1, 2]}])
    done = _done(records)
    assert done["a"]["stop_reason"] == "deadline" and done["a"]["n_tokens"] == 0
    assert done["b"]["stop_reason"] == "max_tokens" and done["b"]["n_tokens"] == 5
    assert records[-1]["stats"]["serve/deadline_total"] == 1


@pytest.mark.parametrize("num_blocks", [None, 5], ids=["default", "five"])
def test_cli_serve_num_blocks_sets_the_pool(tmp_path, num_blocks):
    """`serve --num-blocks N` sizes the pool at N blocks (the JAX flag);
    without it, max_batch full-length requests (2 x 48 / 8 = 12)."""
    flags = [] if num_blocks is None else ["--num-blocks", str(num_blocks)]
    records = _serve_cli(tmp_path, [{"id": "a", "prompt": [1, 2, 3]}], *flags)
    stats = records[-1]["stats"]
    assert stats["decode/cache_blocks_total"] == (num_blocks or 12)
    assert stats["serve/requests_completed"] == 1
