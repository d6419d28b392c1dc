from llm_training_tpu_torch.data.pre_training.collator import PreTrainingDataCollator
from llm_training_tpu_torch.data.pre_training.datamodule import (
    PackingMethod,
    PreTrainingDataModule,
    PreTrainingDataModuleConfig,
)

__all__ = [
    "PackingMethod",
    "PreTrainingDataModule",
    "PreTrainingDataModuleConfig",
    "PreTrainingDataCollator",
]
