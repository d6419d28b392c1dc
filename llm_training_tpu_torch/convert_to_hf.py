"""Convert a checkpoint of the port to a HuggingFace model directory.

Counterpart of `scripts/convert_to_hf.py`: the model is rebuilt from the
run config embedded in the checkpoint (`meta.json`), only the parameters
are read (not the optimizer's state; for DPO and GRPO the policy's, not
the frozen reference's), and `hf_io.save_hf_checkpoint` writes the
safetensors shards and `config.json`.

    python -m llm_training_tpu_torch.convert_to_hf <checkpoint_dir> <output_dir> \\
        [--step N] [--dtype bfloat16] [--tokenizer PATH]

Exporting a tokenizer needs the tokenizer modules (ROADMAP A.5): when one
is named (here or in the run config's data node), the port logs a warning
and writes the weights and `config.json` only (ROADMAP C.27).
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import torch
import torch.distributed.checkpoint as dcp

from llm_training_tpu_torch.cli.config import instantiate_from_config
from llm_training_tpu_torch.lms.dpo import PairObjective
from llm_training_tpu_torch.models.hf_io import save_hf_checkpoint
from llm_training_tpu_torch.resilience import durability
from llm_training_tpu_torch.trainer.checkpoint import _SafeReader, _single_process

logger = logging.getLogger("convert_to_hf")


def load_checkpoint(ckpt_dir: Path, step: int | None) -> tuple[torch.nn.Module, dict, dict]:
    """(the policy model's structure on the meta device, its parameters
    read from the step on the host, the step's meta) of a checkpoint."""
    steps = durability.committed_steps(ckpt_dir)
    step = step if step is not None else (steps[-1] if steps else None)
    if step is None or step not in steps:
        raise SystemExit(f"no checkpoint step {'' if step is None else step} found in "
                         f"{ckpt_dir} (committed: {steps})")
    path = durability.step_dir(ckpt_dir, step)
    logger.info("reading step %d from %s", step, ckpt_dir)
    meta = json.loads((path / "meta.json").read_text())
    run_config = meta.get("config") or {}
    if "model" not in run_config:
        raise SystemExit("checkpoint has no embedded config; pass a checkpoint written by "
                         "`python -m llm_training_tpu_torch fit`")
    objective = instantiate_from_config(run_config["model"],
                                        default_class="llm_training_tpu.lms.CLM")
    model = objective.config.model.get_model(device="meta")
    # a policy and reference pair (DPO, GRPO) stores the policy under `policy.`
    prefix = "model.policy." if isinstance(objective, PairObjective) else "model."
    params = {name: torch.empty(t.shape, dtype=t.dtype)
              for name, t in model.state_dict().items()}
    wanted = {prefix + name: tensor for name, tensor in params.items()}
    try:
        dcp.load(wanted, storage_reader=_SafeReader(path), no_dist=_single_process())
    except dcp.CheckpointException as e:  # a BaseException: not an Exception
        raise RuntimeError(f"reading the parameters of step {step} from {path} failed: {e}") from e
    return model, params, meta


def _tokenizer_from_config(run_config: dict):
    init_args = (run_config.get("data") or {}).get("init_args") or {}
    tokenizer = init_args.get("tokenizer")
    if isinstance(tokenizer, dict):
        return tokenizer.get("path")
    return tokenizer


def convert_checkpoint(
    ckpt_dir: str | Path,
    output_dir: str | Path,
    step: int | None = None,
    dtype: str = "bfloat16",
    tokenizer_path: str | None = None,
) -> Path:
    model, params, meta = load_checkpoint(Path(ckpt_dir).absolute(), step)
    out = save_hf_checkpoint(params, model.config, output_dir, dtype=dtype)
    logger.info("weights + config.json written to %s", out)
    tokenizer_src = tokenizer_path or _tokenizer_from_config(meta.get("config") or {})
    if tokenizer_src is not None:
        logger.warning("tokenizer %s not exported: the tokenizer modules are not ported "
                       "(ROADMAP A.5); weights and config.json only", tokenizer_src)
    else:
        logger.warning("no tokenizer in config and none given; skipping tokenizer export")
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint_dir")
    parser.add_argument("output_dir")
    parser.add_argument("--step", type=int, default=None)
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["bfloat16", "float16", "float32"])
    parser.add_argument("--tokenizer", default=None,
                        help="tokenizer path (defaults to the one in the embedded config)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    convert_checkpoint(args.checkpoint_dir, args.output_dir, step=args.step, dtype=args.dtype,
                       tokenizer_path=args.tokenizer)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
