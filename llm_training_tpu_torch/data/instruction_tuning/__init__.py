from llm_training_tpu_torch.data.instruction_tuning.collator import InstructionTuningDataCollator
from llm_training_tpu_torch.data.instruction_tuning.datamodule import (
    InstructionTuningDataModule,
    InstructionTuningDataModuleConfig,
    OverlongHandlingMethod,
    PackingMethod,
)

__all__ = [
    "InstructionTuningDataModule",
    "InstructionTuningDataModuleConfig",
    "InstructionTuningDataCollator",
    "OverlongHandlingMethod",
    "PackingMethod",
]
