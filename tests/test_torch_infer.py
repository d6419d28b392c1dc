"""Port parity of `generate`, `evaluate` and the checkpoint-driven commands
on the CPU: the port's `InferenceEngine` against the JAX one (greedy and
sampled tokens, stop reasons, lengths, logprobs) on ragged left-padded
prompts, `run_evaluation` against JAX's, `serve --config` against
`generate`, and the whole lifecycle through the CLI. The same numpy
weights go to both packages (fp32).
"""

import io
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_training_tpu.infer import GenerateConfig as JaxGenerateConfig
from llm_training_tpu.infer import InferenceEngine as JaxEngine
from llm_training_tpu.infer import SamplingConfig as JaxSamplingConfig
from llm_training_tpu.infer import run_evaluation as jax_run_evaluation
from llm_training_tpu.infer.sampling import sample_tokens_with_logprob as jax_sample
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.parallel import MeshConfig
from llm_training_tpu.parallel.mesh import build_mesh
from llm_training_tpu.trainer.state import TrainState as JaxTrainState
from llm_training_tpu_torch import prng
from llm_training_tpu_torch.cli.main import build_parser, run_serve
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.data.dummy import DummyDataModule, DummyDataModuleConfig
from llm_training_tpu_torch.infer.cache import cache_bytes, init_decode_state
from llm_training_tpu_torch.infer.engine import GenerateConfig, InferenceEngine, _left_pad
from llm_training_tpu_torch.infer.evaluate import run_evaluation
from llm_training_tpu_torch.infer.sampling import SamplingConfig, sample_tokens_with_logprob
from llm_training_tpu_torch.lms.clm import CLM, CLMConfig
from llm_training_tpu_torch.models.llama.config import LlamaConfig
from llm_training_tpu_torch.models.llama.from_jax import state_dict_from_jax
from llm_training_tpu_torch.models.llama.model import Llama
from llm_training_tpu_torch.trainer.trainer import Trainer, TrainerConfig

# the tiny Llama of tests/test_infer.py
TINY = dict(
    vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
    attention_impl="xla", compute_dtype="float32", param_dtype="float32",
)
PROMPTS = [[3, 17, 42, 7, 11], [5, 9], [1, 2, 3]]
DATA = dict(batch_size=8, max_length=16, num_samples=48, vocab_size=64, validation_split=16)


@pytest.fixture(scope="module")
def weights():
    model = JaxLlama(JaxLlamaConfig(**TINY))
    variables = jax.device_get(nn.meta.unbox(model.init(jax.random.key(0), np.zeros((1, 4), np.int32))))
    return model, variables


def _port(variables) -> Llama:
    config = LlamaConfig.from_dict(TINY)
    model = Llama(config, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, config))
    return model.eval()


# ---------------------------------------------------------------- generate


SAMPLINGS = {
    "greedy": dict(),
    "temperature": dict(temperature=0.8),
    "top_k_top_p": dict(temperature=1.3, top_k=8, top_p=0.9),
}


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_generate_matches_jax_engine(weights, sampling):
    """Ragged left-padded prompts with an EOS that stops one row early:
    tokens, stop reasons and lengths identical to the JAX engine's (sampled
    ones for the same seed), logprobs within 1e-5."""
    model, variables = weights
    jax_engine = JaxEngine(model, variables)
    greedy = jax_engine.generate(PROMPTS, JaxGenerateConfig(max_new_tokens=8))
    eos = greedy["tokens"][0][2]  # row 0 stops at its 3rd token when greedy
    kw = dict(max_new_tokens=8, eos_token_id=eos, seed=3)
    expected = jax_engine.generate(
        PROMPTS, JaxGenerateConfig(**kw, sampling=JaxSamplingConfig(**SAMPLINGS[sampling])))
    result = InferenceEngine(_port(variables), device="cpu").generate(
        PROMPTS, GenerateConfig(**kw, sampling=SamplingConfig(**SAMPLINGS[sampling])))
    for key in ("tokens", "sequences", "lengths", "stop_reasons"):
        assert result[key] == expected[key], key
    if sampling == "greedy":
        assert result["stop_reasons"][0] == "eos" and result["lengths"][0] == 3
    for got, want in zip(result["logprobs"], expected["logprobs"]):
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert set(result["stats"]) == set(expected["stats"])
    assert result["stats"]["decode/cache_bytes"] == expected["stats"]["decode/cache_bytes"]


def test_prefill_logits_match_full_forward(weights):
    """The left-padded prefill through the dense cache gives each row's
    last-column logits of the model's plain forward on the unpadded prompt;
    the cache's index advances by the width and its pad slots stay 0."""
    model = _port(weights[1])
    ids, pad_lens = _left_pad(PROMPTS, 0)
    width = ids.shape[1]
    state = init_decode_state(model.config, len(PROMPTS), width + 4, device="cpu")
    columns = np.arange(width)[None, :]
    with torch.no_grad():
        out = model(
            input_ids=torch.as_tensor(ids).long(),
            segment_ids=torch.as_tensor((columns >= pad_lens[:, None]).astype(np.int32)),
            position_ids=torch.as_tensor(np.maximum(columns - pad_lens[:, None], 0)).long(),
            decode_state=state,
        )
        for row, prompt in enumerate(PROMPTS):
            full = model(input_ids=torch.tensor([prompt])).logits[0, -1]
            torch.testing.assert_close(out.logits[row, -1], full, rtol=2e-5, atol=2e-5)
    assert out.decode_state.index == width
    assert out.decode_state.segment_ids[:, :width].sum(1).tolist() == [len(p) for p in PROMPTS]


def test_generate_cache_sizing_stats_and_errors(weights):
    engine = InferenceEngine(_port(weights[1]), device="cpu")
    with pytest.raises(ValueError, match="max_length"):
        engine.generate([[1, 2, 3]], GenerateConfig(max_new_tokens=8, max_length=4))
    with pytest.raises(ValueError, match="empty prompt"):
        engine.generate([[1], []])
    result = engine.generate([[1, 2, 3]], GenerateConfig(max_new_tokens=4, cache_dtype="bfloat16"))
    stats = result["stats"]
    # [L=2, B=1, S=7, H=2, D=8] bf16 k+v, as the JAX engine's
    assert stats["decode/cache_bytes"] == 2 * (2 * 1 * 7 * 2 * 8) * 2
    assert stats["decode/new_tokens"] == 4 and stats["decode/max_length"] == 7
    assert stats["decode/prefill_time_s"] > 0
    state = init_decode_state(engine.model.config, 2, 8, device="cpu")
    assert state.k.dtype == torch.float32 and state.index == 0
    assert cache_bytes(init_decode_state(engine.model.config, 2, 8, "bfloat16")) == cache_bytes(state) // 2
    for bad in (dict(max_new_tokens=0), dict(max_length=0)):
        with pytest.raises(ValueError):
            GenerateConfig(**bad)


def test_generate_without_cuda_raises(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the engine would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(_port(weights[1]))


@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_sampled_logprob_matches_jax(sampling):
    """The chosen token's logprob is JAX's: the raw log-softmax when greedy,
    the temperature-scaled, filtered distribution when sampling."""
    logits = np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32) * 3
    tokens, logprobs = sample_tokens_with_logprob(
        torch.from_numpy(logits), prng.key(11), SamplingConfig(**SAMPLINGS[sampling]))
    jtokens, jlogprobs = jax_sample(jnp.asarray(logits), jax.random.key(11),
                                    JaxSamplingConfig(**SAMPLINGS[sampling]))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))
    np.testing.assert_allclose(logprobs.numpy(), np.asarray(jlogprobs), atol=1e-6)


# ---------------------------------------------------------------- evaluate


def test_run_evaluation_matches_jax_and_val_loss(weights, devices):
    """The token-weighted NLL over the packed validation batches equals
    JAX's `run_evaluation` within 1e-5 and the port trainer's `val_loss`;
    the split / limit errors are JAX's."""
    model, variables = weights
    jax_objective = JaxCLM(JaxCLMConfig(model=JaxProvider(
        model_class="llm_training_tpu.models.Llama", model_kwargs=TINY)))
    from llm_training_tpu.data import DummyDataModule as JaxDummy
    from llm_training_tpu.data import DummyDataModuleConfig as JaxDummyConfig

    expected = jax_run_evaluation(
        jax_objective, JaxTrainState.create(variables, (), jax.random.key(0)),
        JaxDummy(JaxDummyConfig(**DATA)), build_mesh(MeshConfig(), devices),
    )
    objective = CLM(CLMConfig(), model=_port(variables))
    result = run_evaluation(objective, DummyDataModule(DummyDataModuleConfig(**DATA)), "cpu")
    assert result["eval/batches"] == expected["eval/batches"] == 2.0
    assert result["eval/tokens"] == expected["eval/tokens"] == 2 * 8 * 15
    assert abs(result["eval/nll_per_token"] - expected["eval/nll_per_token"]) < 1e-5
    np.testing.assert_allclose(result["eval/perplexity"], np.exp(result["eval/nll_per_token"]),
                               rtol=1e-6)
    trainer = Trainer(TrainerConfig(), device="cpu")
    val = trainer.validate(objective, DummyDataModule(DummyDataModuleConfig(**DATA)),
                           trainer.init_state(objective, with_optimizer=False)[0])
    assert abs(val["val_loss"] - result["eval/nll_per_token"]) < 1e-6
    with pytest.raises(ValueError, match="limit_batches"):
        run_evaluation(objective, DummyDataModule(DummyDataModuleConfig(**DATA)), "cpu",
                       split="train")
    with pytest.raises(ValueError, match="split"):
        run_evaluation(objective, DummyDataModule(DummyDataModuleConfig(**DATA)), "cpu",
                       split="test")


# ---------------------------------------------------------------- the commands


def _config(tmp_path, **trainer) -> str:
    config = {
        "seed_everything": 7,
        "trainer": {
            "max_steps": 2, "log_every_n_steps": 1, "checkpoint_every_n_steps": 2,
            "limit_val_batches": 1,
            "checkpoint": {"dirpath": str(tmp_path / "ckpt"), "max_to_keep": 2},
            **trainer,
        },
        "model": {
            "class_path": "llm_training_tpu.lms.CLM",
            "init_args": {
                "model": {"model_class": "llm_training_tpu.models.Llama", "model_kwargs": TINY},
                "optim": {"learning_rate": 1e-3},
            },
        },
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule",
                 "init_args": {**DATA, "num_samples": 32, "validation_split": 8}},
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(config))
    return str(path)


def _records(capsys) -> list[dict]:
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _serve(config_path, prompts, *flags) -> list[dict]:
    args = build_parser().parse_args(["serve", "--config", config_path, "--device", "cpu",
                                      "--max-new-tokens", "6", *flags])
    stdin = io.StringIO("".join(json.dumps({"id": f"r{i}", "prompt": p}) + "\n"
                                for i, p in enumerate(prompts)))
    stdout = io.StringIO()
    assert run_serve(args, stdin=stdin, stdout=stdout) == 0
    return [json.loads(line) for line in stdout.getvalue().splitlines()]


def test_cli_lifecycle_on_cpu(tmp_path, capsys):
    """fit -> fit (resumed to step 4) -> validate -> generate -> evaluate ->
    serve, all from the checkpoint, on --device cpu; serve's greedy tokens
    are generate's (fp32)."""
    path = _config(tmp_path)
    assert cli_main(["fit", "--config", path, "--device", "cpu"]) == 0
    assert cli_main(["fit", "--config", path, "--device", "cpu", "trainer.max_steps=4"]) == 0
    steps = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert steps == ["step_2", "step_4"]
    meta = json.loads((tmp_path / "ckpt" / "step_4" / "meta.json").read_text())
    assert meta["counters"]["consumed_samples"] == 4 * 8
    capsys.readouterr()

    assert cli_main(["validate", "--config", path, "--device", "cpu"]) == 0
    (val,) = _records(capsys)
    assert cli_main(["evaluate", "--config", path, "--device", "cpu", "--limit-batches", "1"]) == 0
    (evaluation,) = _records(capsys)
    assert abs(evaluation["eval/nll_per_token"] - val["val_loss"]) < 1e-6
    assert cli_main(["validate", "--config", path, "--device", "cpu", "--ckpt-path", "2"]) == 0
    assert _records(capsys)[0]["val_loss"] != val["val_loss"]

    prompts = [[3, 17, 42], [5, 9, 11, 13, 2]]
    assert cli_main(["generate", "--config", path, "--device", "cpu", "--max-new-tokens", "6",
                     "--logprobs", *(f"--prompt-tokens={','.join(map(str, p))}" for p in prompts)
                     ]) == 0
    *rows, stats = _records(capsys)
    assert [r["prompt"] for r in rows] == prompts
    assert all(r["n_tokens"] == 6 and len(r["logprobs"]) == 6 and r["sequence"] == r["prompt"] +
               r["tokens"] for r in rows)
    assert {"decode/prefill_time_s", "decode/tokens_per_sec", "decode/cache_bytes"} <= set(
        stats["stats"])

    events = _serve(path, prompts)
    done = {e["id"]: e for e in events if e["type"] == "done"}
    assert [done[f"r{i}"]["tokens"] for i in range(2)] == [r["tokens"] for r in rows]
    assert events[-1]["type"] == "stats"
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == steps


def test_serve_from_checkpoint_matches_generate(tmp_path, weights):
    """JAX weights saved as a port checkpoint: `serve --config` answers
    ragged prompts with `generate`'s greedy tokens (fp32), and restores the
    newest step unless `--ckpt-path` names another."""
    from llm_training_tpu_torch.cli.main import build_fit
    from llm_training_tpu_torch.cli.config import load_config

    path = _config(tmp_path)
    trainer, objective, _ = build_fit(load_config(path), "cpu")
    state, _ = trainer.init_state(objective)
    state.model.load_state_dict(_port(weights[1]).state_dict())
    trainer.checkpointer.save(3, state)
    trainer.checkpointer.close()
    # both stop at the config's eos (Llama's default, 2)
    expected = InferenceEngine(_port(weights[1]), device="cpu").generate(
        PROMPTS, GenerateConfig(max_new_tokens=6, eos_token_id=2))
    done = {e["id"]: e for e in _serve(path, PROMPTS) if e["type"] == "done"}
    assert [done[f"r{i}"]["tokens"] for i in range(3)] == expected["tokens"]
    with pytest.raises(FileNotFoundError, match="step 5 not found"):
        _serve(path, PROMPTS, "--ckpt-path", "5")
    with pytest.raises(SystemExit, match="excludes"):
        _serve(path, PROMPTS, "--preset", "llama-3.1-8b")


def test_config_imports_classes_outside_the_jax_package_by_name():
    """A class path outside the table and outside the JAX package is
    imported by name (as the JAX config imports every path), its config
    class found beside it; the JAX package's own paths are refused."""
    from llm_training_tpu_torch.cli.config import instantiate_from_config

    built = instantiate_from_config({
        "class_path": "llm_training_tpu_torch.data.dummy.DummyDataModule",
        "init_args": {"batch_size": 2, "num_samples": 4, "max_length": 8},
    })
    assert isinstance(built, DummyDataModule) and built.config.batch_size == 2
    with pytest.raises(NotImplementedError, match="not ported"):
        instantiate_from_config({"class_path": "llm_training_tpu.data.HFDataModule"})
    with pytest.raises(ValueError, match="no JSONDecoderConfig"):
        instantiate_from_config({"class_path": "json.JSONDecoder"})
