"""Tokenize and pack a corpus ahead of training, on the host's CPUs.

Counterpart of `scripts/pre_process_data.py`: builds the `data` node of a
run config (the same JSON file `fit` reads), runs its pre-processing with
`--num-proc` workers, saves the result to `--output-path` (default: the
node's `pre_processed_data_path`, which a later `fit` then loads instead of
processing again) and writes `info.txt` there with the per-source token
table of a pre-training module.

    python -m llm_training_tpu_torch.pre_process_data --config run.json \\
        [--num-proc N] [--output-path DIR]

It needs `datasets`, `transformers` and `tokenizers` (the host's, not the
card's machine).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from llm_training_tpu_torch.cli.config import instantiate_from_config, load_config


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--num-proc", type=int, default=None)
    parser.add_argument("--output-path", default=None,
                        help="defaults to data.init_args.pre_processed_data_path")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    node = load_config(args.config)["data"]
    if args.num_proc is not None:
        node.setdefault("init_args", {})["num_proc"] = args.num_proc
    datamodule = instantiate_from_config(node)

    output_path = args.output_path or datamodule.config.pre_processed_data_path
    if output_path is None:
        raise SystemExit("set --output-path or data.init_args.pre_processed_data_path")

    # process again even when a processed copy exists at the target
    datamodule.config.pre_processed_data_path = None
    datamodule.setup()
    datamodule.config.pre_processed_data_path = output_path
    datamodule.save_pre_processed_data(output_path)

    if hasattr(datamodule, "tokens_table"):
        info = datamodule.tokens_table()
        (Path(output_path) / "info.txt").write_text(info + "\n")
        print(info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
