"""5-step fits of the Llama graph's variants (fp32, CPU):

- one type for each norm scheme (pre: qwen2's biases; post: OLMo-2; the
  parallel block: Phi; NeoX's two-norm parallel block: Pythia; GLM-4's
  sandwich), and Granite under NEFTune, each from an HF directory that
  JAX exported: the port's `fit` (CLI) against JAX's `Trainer` on one
  device, losses within rtol 1e-4;
- a tensor-parallel world: 2 processes under gloo (`tensor 2`,
  `tests/torch_mesh_world.py`) fitting a HunYuan config with q/k/v/o and
  MLP biases and post-rope qk-norms, against the same fit in this one
  process: losses within rtol 1e-4 and final parameters within 1e-5 in
  norm per tensor (the mesh fits' tolerances). A rowwise projection's bias
  (o_proj, down_proj) added once per rank would move both.
The world starts first and runs beside the JAX fits."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_llama_variant_cases import configs, hf_config, random_params

from llm_training_tpu.data.dummy import DummyDataModule as JaxDummy
from llm_training_tpu.data.dummy import DummyDataModuleConfig as JaxDummyConfig
from llm_training_tpu.lms import CLM as JaxCLM
from llm_training_tpu.lms import CLMConfig as JaxCLMConfig
from llm_training_tpu.lms import ModelProvider as JaxProvider
from llm_training_tpu.models import Llama as JaxLlama
from llm_training_tpu.models import hf_io as jax_hf_io
from llm_training_tpu.optim import OptimConfig as JaxOptimConfig
from llm_training_tpu.trainer import Trainer as JaxTrainer
from llm_training_tpu.trainer import TrainerConfig as JaxTrainerConfig
from llm_training_tpu_torch.cli.main import main as cli_main
from llm_training_tpu_torch.models import hf_io
from llm_training_tpu_torch.models.llama import hf_conversion as conv
from llm_training_tpu_torch.models.llama.model import Llama

ROOT = Path(__file__).resolve().parent.parent
SCHEMES = {"pre": "qwen2", "post": "olmo2", "parallel": "phi", "parallel2": "gpt_neox",
           "sandwich": "glm4"}
# one more fit: NEFTune's noise on Granite, whose embeddings are scaled
# after the noise lands (as JAX adds it to the raw `inputs_embeds`)
FITS = {**{scheme: (model_type, {}) for scheme, model_type in SCHEMES.items()},
        "granite-neftune": ("granite", {"neftune_alpha": 5.0})}
DATA = dict(batch_size=4, max_length=16, num_samples=40, validation_split=0, vocab_size=128)
OPTIM = dict(learning_rate=2e-3, warmup_steps=2)
STEPS = 5
TP_FIELDS = dict(attention_bias=True, mlp_bias=True)  # on hunyuan_v1_dense's case
WORLD_TIMEOUT_S = 240


def _port_config(root: Path, name: str, model: dict, hf_dir: Path, mesh=None,
                 objective=None) -> Path:
    trainer = {"max_steps": STEPS, "log_every_n_steps": 1, "limit_val_batches": 0,
               "loggers": [{"class_path": "llm_training_tpu.callbacks.JsonlLogger",
                            "init_args": {"save_dir": str(root), "project": "p",
                                          "name": name}}]}
    if mesh is not None:
        trainer["mesh"] = mesh
    trainer["checkpoint"] = {"dirpath": str(root / f"{name}-ckpt"), "async_save": False}
    config = {
        "seed_everything": 42, "trainer": trainer,
        "model": {"class_path": "llm_training_tpu.lms.CLM", "init_args": {
            "model": {"model_class": "Llama", "model_kwargs": model},
            "pre_trained_weights": str(hf_dir), "optim": OPTIM, **(objective or {})}},
        "data": {"class_path": "llm_training_tpu.data.DummyDataModule", "init_args": DATA},
    }
    path = root / f"{name}.json"
    path.write_text(json.dumps(config))
    return path


def _losses(root: Path, name: str) -> list[float]:
    rows = [json.loads(line) for line in (root / "p" / name / "metrics.jsonl").read_text()
            .splitlines()]
    return [r["loss"] for r in rows if "loss" in r]


class _Track:
    def __init__(self):
        self.losses: dict[int, float] = {}

    def on_step_end(self, trainer, step, metrics):
        self.losses[step] = float(metrics["loss"])


def _restored(path: Path) -> dict[str, torch.Tensor]:
    from llm_training_tpu_torch.cli.config import load_config
    from llm_training_tpu_torch.cli.main import build_fit

    trainer, objective, _ = build_fit(load_config(path), "cpu")
    return {k: v.detach() for k, v in trainer.restore_for_inference(objective).model
            .state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices):
    root = tmp_path_factory.mktemp("variant-fits")
    # the tensor-parallel world's weights: random (biases included), the
    # port's own export (JAX's conversion has no MLP-bias keys, ROADMAP C.41)
    tp_config = conv.config_from_hf({**hf_config("hunyuan_v1_dense"), **TP_FIELDS},
                                    compute_dtype="float32", param_dtype="float32",
                                    attention_impl="xla")
    model = Llama(tp_config, device="cpu")
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for param in model.parameters():
            param.copy_(0.1 * torch.randn(param.shape, generator=gen))
    hf_io.save_hf_checkpoint(model.state_dict(), tp_config, root / "hf-tp", dtype="float32")
    tp_kwargs = dataclasses.asdict(tp_config)
    world_path = _port_config(root, "tp", tp_kwargs, root / "hf-tp",
                              mesh={"tensor_parallel_size": 2})
    plan = root / "plan.json"
    plan.write_text(json.dumps({"commands": [{"argv": ["fit", "--config", str(world_path),
                                                       "--device", "cpu"]}],
                                "out": str(root / "ranks")}))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "tests")])
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(ROOT / "tests" / "torch_mesh_world.py"), str(plan)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    out = {}
    for name, (model_type, objective) in FITS.items():
        jax_config, config = configs(model_type)
        hf_dir = root / f"hf-{name}"
        jax_hf_io.save_hf_checkpoint(random_params(JaxLlama(jax_config)), jax_config, hf_dir,
                                     dtype="float32")
        kwargs = {k: v for k, v in jax_config.model_dump().items()
                  if k in jax_config.model_fields_set or k in ("compute_dtype", "param_dtype")}
        track = _Track()
        jax_objective = JaxCLM(JaxCLMConfig(
            model=JaxProvider(model_class="llm_training_tpu.models.Llama", model_kwargs=kwargs),
            pre_trained_weights=str(hf_dir), optim=JaxOptimConfig(**OPTIM), **objective))
        JaxTrainer(JaxTrainerConfig(max_steps=STEPS, log_every_n_steps=1, seed=42),
                   callbacks=[track], devices=devices[:1]).fit(jax_objective,
                                                               JaxDummy(JaxDummyConfig(**DATA)))
        path = _port_config(root, name, dataclasses.asdict(config), hf_dir, objective=objective)
        config_json = json.loads(path.read_text())
        config_json["trainer"].pop("checkpoint")
        path.write_text(json.dumps(config_json))
        assert cli_main(["fit", "--config", str(path), "--device", "cpu"]) == 0
        out[name] = (_losses(root, name), [track.losses[s] for s in sorted(track.losses)])

    one = _port_config(root, "tp-one", tp_kwargs, root / "hf-tp")
    assert cli_main(["fit", "--config", str(one), "--device", "cpu"]) == 0
    try:
        log, _ = proc.communicate(timeout=WORLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
        pytest.fail(f"the 2-process world timed out:\n{log[-4000:]}")
    assert proc.returncode == 0, log[-6000:]
    out["tp"] = dict(world=_losses(root, "tp"), one=_losses(root, "tp-one"),
                     world_params=_restored(world_path), one_params=_restored(one))
    return out


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_fit_of_each_norm_scheme_matches_jax(runs, scheme):
    ours, theirs = runs[scheme]
    assert len(ours) == len(theirs) == STEPS
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


def test_neftune_noise_lands_before_granite_s_embedding_multiplier(runs):
    """NEFTune on Granite (embedding_multiplier 12): JAX adds the noise to
    the raw embeddings, which the model then scales; the port's fit gives
    JAX's losses within rtol 1e-4."""
    ours, theirs = runs["granite-neftune"]
    assert len(ours) == len(theirs) == STEPS
    np.testing.assert_allclose(ours, theirs, rtol=1e-4)


def test_tensor_parallel_fit_adds_rowwise_biases_once(runs):
    tp = runs["tp"]
    assert len(tp["world"]) == len(tp["one"]) == STEPS
    np.testing.assert_allclose(tp["world"], tp["one"], rtol=1e-4)
    got, want = tp["world_params"], tp["one_params"]
    assert set(got) == set(want)
    assert {n for n in got if n.endswith(("o_proj.bias", "down_proj.bias"))}
    for name, value in want.items():
        err = float(torch.linalg.vector_norm(got[name] - value) / torch.linalg.vector_norm(value))
        assert err <= 1e-5, (name, err)
