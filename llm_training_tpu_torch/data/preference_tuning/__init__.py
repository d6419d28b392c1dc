from llm_training_tpu_torch.data.preference_tuning.collator import PreferenceTuningDataCollator
from llm_training_tpu_torch.data.preference_tuning.datamodule import (
    PreferenceTuningDataModule,
    PreferenceTuningDataModuleConfig,
)

__all__ = [
    "PreferenceTuningDataModule",
    "PreferenceTuningDataModuleConfig",
    "PreferenceTuningDataCollator",
]
