"""The data slice end to end through both packages' commands, on a local
jsonl corpus and the fixtures' tokenizer saved to `tmp_path`, a tiny Llama
starting from one HF directory (`pre_trained_weights`), fp32 on the CPU:

- `fit` on an instruction-tuning config (GROUP_BY_LENGTH) and on a
  pre-training config (BEST_FIT_BIN_PACKING), 5 steps: the port's losses
  within rtol 1e-4 of JAX's;
- `pre_process_data`: the port's `info.txt` equals the JAX script's;
- `generate --prompt` after a 1-step fit at learning rate 0: the same
  prompt ids and tokens;
- `convert_to_hf` of that checkpoint: the same tokenizer files and chat
  template beside the weights (ROADMAP C.27);
- a resumed `fit`, a read-only restore and `convert_to_hf` read the HF
  source directory zero times; a fresh fit reads it once (ROADMAP C.28).

JAX runs in one subprocess (one CPU device), started before the port's
runs so the two overlap. Every HF cache is under `tmp_path`."""

import json
import os
import subprocess
import sys
from pathlib import Path

import flax.linen as nn
import jax
import numpy as np
import pytest

from data_fixtures import _CORPUS, tiny_tokenizer
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import LlamaConfig as JaxLlamaConfig
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.convert_to_hf import main as convert_main
from llm_training_tpu_torch.lms import base as lms_base
from llm_training_tpu_torch.pre_process_data import main as pre_process_main

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(vocab_size=512, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=500000.0, compute_dtype="float32", param_dtype="float32")
PROMPTS = ["the quick brown fox", "sphinx of black quartz"]
GENERATE = ["--max-new-tokens", "6", *(a for p in PROMPTS for a in ("--prompt", p))]

# the JAX package's commands on the configs in argv[1]
_JAX_RUNS = r"""
import sys
root = sys.argv[1]
sys.path.insert(0, sys.argv[2] + "/scripts")
from llm_training_tpu.cli.main import main
import convert_to_hf, pre_process_data
for name in ("it", "pt", "gen"):
    assert main(["fit", "--config", f"{root}/jax-{name}.json"]) == 0
assert pre_process_data.main(["--config", f"{root}/jax-pt.json", "--num-proc", "1",
                              "--output-path", f"{root}/jax-prep"]) == 0
print("---generate---", flush=True)
assert main(["generate", "--config", f"{root}/jax-gen.json", *sys.argv[3:]]) == 0
print("---end---", flush=True)
assert convert_to_hf.main([f"{root}/jax-ckpt", f"{root}/jax-hf", "--dtype", "float32"]) == 0
"""


def _config(root: Path, package: str, kind: str) -> Path:
    """One run's config (JSON, which JAX's YAML loader reads too); the two
    packages' files differ only in where they write."""
    data = {"tokenizer": str(root / "tok"), "batch_size": 2, "enable_cache": False,
            "dataset_kwargs": {"path": "json", "cache_dir": str(root / f"{package}-hf-cache")}}
    if kind == "pt":
        data.update(max_length=32, packing_method="best_fit_bin_packing")
        data["dataset_kwargs"]["data_files"] = str(root / "text.jsonl")
        class_path = "llm_training_tpu.data.PreTrainingDataModule"
    else:
        data.update(chat_template="chatml", max_length=64, packing_method="group_by_length")
        data["dataset_kwargs"]["data_files"] = str(root / "chat.jsonl")
        class_path = "llm_training_tpu.data.InstructionTuningDataModule"
    trainer = {"max_steps": 5, "log_every_n_steps": 1,
               "loggers": [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                            "init_args": {"save_dir": str(root / package), "project": "p",
                                          "name": kind}}]}
    optim = {"learning_rate": 1e-3, "warmup_steps": 1}
    if kind == "gen":
        trainer.update(max_steps=1, checkpoint={"dirpath": str(root / f"{package}-ckpt"),
                                                "async_save": False})
        optim = {"learning_rate": 0.0}
    config = {
        "seed_everything": 42,
        "trainer": trainer,
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": {**TINY, "attention_impl": "xla"}},
            "pre_trained_weights": str(root / "hf"), "optim": optim}},
        "data": {"class_path": class_path, "init_args": data},
    }
    path = root / f"{package}-{kind}.json"
    path.write_text(json.dumps(config))
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The corpus (a chat jsonl, a text jsonl with two sources), the
    tokenizer directory, the HF weights and both packages' configs."""
    root = tmp_path_factory.mktemp("data-fit")
    tiny_tokenizer().save_pretrained(root / "tok")
    with open(root / "chat.jsonl", "w") as f:
        for i in range(40):
            turns = [{"role": "user", "content": _CORPUS[i % 8]},
                     {"role": "assistant", "content": _CORPUS[(i + 1) % 8]}]
            if i % 3 == 0:
                turns += [{"role": "user", "content": _CORPUS[(i + 5) % 8]},
                          {"role": "assistant", "content": _CORPUS[(i + 2) % 8]}]
            f.write(json.dumps({"messages": turns}) + "\n")
    with open(root / "text.jsonl", "w") as f:
        for i in range(60):
            text = " ".join(_CORPUS[(i + k) % 8] for k in range(1 + i % 4))
            f.write(json.dumps({"text": text, "source": ["wiki", "code"][i % 2]}) + "\n")
    jax_config = JaxLlamaConfig(**TINY, attention_impl="xla")
    params = jax.device_get(nn.meta.unbox(JaxLlama(jax_config).init(
        jax.random.key(0), np.zeros((1, 4), np.int32))))
    jax_hf_io.save_hf_checkpoint(params, jax_config, root / "hf", dtype="float32")
    for package in ("jax", "port"):
        for kind in ("it", "pt", "gen"):
            _config(root, package, kind)
    return root


@pytest.fixture(scope="module")
def jax_process(root):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LLMT_") and k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               HF_DATASETS_CACHE=str(root / "jax-hf-home"), HF_DATASETS_DISABLE_PROGRESS_BARS="1")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RUNS, str(root), str(ROOT), *GENERATE],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reads(root):
    """Every read of the HF source by the port's objectives, by run."""
    return {}


_LOAD = lms_base.load_pretrained_params


def _counting(monkeypatch, reads, run):
    reads[run] = 0

    def counted(*args, **kwargs):
        reads[run] += 1
        return _LOAD(*args, **kwargs)

    monkeypatch.setattr(lms_base, "load_pretrained_params", counted)


@pytest.fixture(scope="module")
def port_runs(root, jax_process, reads):
    """The port's commands on its configs (while JAX runs), in process."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for kind in ("it", "pt", "gen"):
            _counting(mp, reads, kind)
            assert cli_main(["fit", "--config", str(root / f"port-{kind}.json"),
                             "--device", "cpu"]) == 0
        assert pre_process_main(["--config", str(root / "port-pt.json"), "--num-proc", "1",
                                 "--output-path", str(root / "port-prep")]) == 0
        _counting(mp, reads, "generate")
        out["generate"] = _generate(root)
        _counting(mp, reads, "convert")
        assert convert_main([str(root / "port-ckpt"), str(root / "port-hf"),
                             "--dtype", "float32"]) == 0
    return out


def _generate(root: Path) -> list[dict]:
    import contextlib
    import io

    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        assert cli_main(["generate", "--config", str(root / "port-gen.json"), "--device", "cpu",
                         *GENERATE]) == 0
    return _records(stdout.getvalue())


def _records(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{") and '"tokens"' in line]


@pytest.fixture(scope="module")
def jax_runs(jax_process):
    stdout, stderr = jax_process.communicate(timeout=600)
    assert jax_process.returncode == 0, stderr[-3000:]
    generated = stdout.split("---generate---", 1)[1].split("---end---", 1)[0]
    return {"generate": _records(generated)}


def _losses(root: Path, package: str, kind: str) -> list[float]:
    rows = (root / package / "p" / kind / "metrics.jsonl").read_text().splitlines()
    return [r["loss"] for r in map(json.loads, rows) if "loss" in r]


@pytest.mark.parametrize("kind", ["it", "pt"], ids=["instruction-tuning", "pre-training"])
def test_fit_on_text_matches_jax(root, port_runs, jax_runs, kind):
    ours, theirs = _losses(root, "port", kind), _losses(root, "jax", kind)
    assert len(ours) == len(theirs) == 5
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)
    assert ours[-1] < ours[0]


def test_pre_process_info_matches_jax(root, port_runs, jax_runs):
    ours = (root / "port-prep" / "info.txt").read_text()
    assert ours == (root / "jax-prep" / "info.txt").read_text()
    assert "wiki" in ours and "code" in ours


def test_generate_prompt_matches_jax(port_runs, jax_runs):
    ours, theirs = port_runs["generate"], jax_runs["generate"]
    assert len(ours) == len(theirs) == len(PROMPTS)
    tokenizer = tiny_tokenizer()
    for a, b, text in zip(ours, theirs, PROMPTS):
        assert a["prompt"] == b["prompt"] == tokenizer(text)["input_ids"]
        assert a["tokens"] == b["tokens"] and len(a["tokens"]) == 6
        assert a["stop_reason"] == b["stop_reason"]


def test_convert_to_hf_exports_the_tokenizer_as_jax(root, port_runs, jax_runs):
    """Besides the weights: the same tokenizer files, byte for byte, with
    the config's chat template (ROADMAP C.27 closed)."""
    def tokenizer_files(path: Path) -> dict[str, bytes]:
        return {p.name: p.read_bytes() for p in sorted(path.iterdir())
                if p.suffix != ".safetensors" and p.name not in ("config.json",
                                                                  "model.safetensors.index.json")}

    ours, theirs = tokenizer_files(root / "port-hf"), tokenizer_files(root / "jax-hf")
    assert ours.keys() == theirs.keys() and "tokenizer.json" in ours
    assert ours == theirs
    from transformers import AutoTokenizer

    exported = AutoTokenizer.from_pretrained(root / "port-hf")
    from llm_training_tpu_torch.data.chat_templates import get_chat_template

    assert exported.chat_template == get_chat_template("chatml")


def test_hf_source_is_read_only_by_fresh_fits(root, port_runs, jax_runs, reads, monkeypatch):
    """Fresh fits read the HF directory once each; the read-only restores of
    `generate` and `convert_to_hf` never; and a fit resumed from the
    checkpoint never (ROADMAP C.28: the port read it before every restore)."""
    assert {k: reads[k] for k in ("it", "pt", "gen", "generate", "convert")} == \
        dict(it=1, pt=1, gen=1, generate=0, convert=0)
    _counting(monkeypatch, reads, "resume")
    assert cli_main(["fit", "--config", str(root / "port-gen.json"), "--device", "cpu",
                     "trainer.max_steps=2"]) == 0
    assert reads["resume"] == 0
    assert len(_losses(root, "port", "gen")) == 2  # step 1, then the resumed step 2
